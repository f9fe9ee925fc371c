"""Pipelines: duplicate marking, BQSR and the streamed transform."""
