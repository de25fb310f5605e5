"""The port's command-line entry points."""
