"""Sequence packing (numpy): packed rows with segment ids and positions."""
