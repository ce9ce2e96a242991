"""Data side of the port: synthetic columns and the feature transforms."""
