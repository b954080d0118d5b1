"""Decode math of the port: layers, attention, parameters and the packed
decode step."""
