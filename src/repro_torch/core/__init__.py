"""Pacing arithmetic the serving scheduler shares with training."""
