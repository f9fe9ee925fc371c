"""Placement of windows on the device, genome-bin partitioning, and the
out-of-core sharded transform and region joins (shuffle, raw shard
spill, interval spill)."""
