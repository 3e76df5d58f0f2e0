"""Launch layer: the serving command line."""
