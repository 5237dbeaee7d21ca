"""SG-FRONT reader, collation into SceneBatch, CLIP text features, fake data."""
