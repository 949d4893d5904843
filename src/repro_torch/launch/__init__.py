"""Launch: the serving entry point."""
