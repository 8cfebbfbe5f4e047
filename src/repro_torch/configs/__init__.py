"""Run configurations of the port."""
