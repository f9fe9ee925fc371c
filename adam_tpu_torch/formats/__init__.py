"""Columnar data model: schema constants, string columns, read batches, variant batches."""
