"""Checkpoints, frames and metrics of the port (numpy files; no JAX)."""
