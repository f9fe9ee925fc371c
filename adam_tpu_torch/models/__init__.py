"""Header dictionaries, genomic coordinates and the known-variant tables."""
