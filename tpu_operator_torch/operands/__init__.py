"""The port's node operands; see ``feature_discovery``."""
