"""File formats of the port (FITS)."""
