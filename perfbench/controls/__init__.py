"""Controls of the output check: runs that show the check can fail."""
