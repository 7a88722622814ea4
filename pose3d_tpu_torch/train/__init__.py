"""Evaluation step and loop, and the weights bridge from the JAX package."""
