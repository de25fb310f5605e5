"""The port's custom-resource types; see ``v1alpha1``."""
