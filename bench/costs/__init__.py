"""Frozen operation and byte counts and the card's data-sheet peaks."""
