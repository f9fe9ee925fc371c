"""Ingest (SAM) and output (Parquet parts)."""
