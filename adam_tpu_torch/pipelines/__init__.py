"""Pipelines: duplicate marking, realignment, BQSR, the streamed
transform, and the region joins."""
