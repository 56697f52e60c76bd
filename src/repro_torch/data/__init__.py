"""The synthetic training corpus."""
