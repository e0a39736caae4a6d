"""Helpers of the port that are not models: rendering."""
