"""The benchmark's plain reference: NumPy only, importing nothing of the
program. ``match.py`` is its entry; the rest are frozen copies of the
port's numpy path (each names its original)."""
