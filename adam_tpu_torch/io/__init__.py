"""Ingest (SAM, VCF) and output (Parquet parts)."""
