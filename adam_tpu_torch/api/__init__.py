"""User-facing dataset handle."""
