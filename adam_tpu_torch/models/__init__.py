"""Header dictionaries."""
