"""Scene evaluation: constraint accuracy, SDF dumps, shape consistency and
MMD / COV / 1-NN point-cloud metrics, with their CLIs."""
