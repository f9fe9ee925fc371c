"""Columnar data model: schema constants, string columns, read batches."""
