"""The benchmark of the PyTorch / CUDA port (`echoscene_torch`): one cell a
run, driven by `BENCHMARK.json` at the root of the checkout.  See
`README.md` here."""
