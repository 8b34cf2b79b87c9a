"""Frozen work and peak tables: bounds, FLOP counts, H100 peaks."""
