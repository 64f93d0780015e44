"""Tracing and step timing."""
