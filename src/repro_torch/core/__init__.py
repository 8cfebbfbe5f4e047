"""Frames, the epoch engine, substrates and stopping rules of the port."""
