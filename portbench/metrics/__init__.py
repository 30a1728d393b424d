"""Per-layer readers: ``metrics/<metric>.py`` has ``read(obs)``."""
