"""Entries: ``entries/<entry>.py`` runs a kind of cell (``run(env)``)."""
