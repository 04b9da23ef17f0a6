"""The closed loops a traffic file names by its `kind` (see traffic.py)."""
