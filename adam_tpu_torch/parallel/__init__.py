"""Placement of windows on the device."""
