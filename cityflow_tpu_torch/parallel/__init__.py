"""Batched simulation: B envs of one scenario in lockstep on one device
(parallel/batch.py)."""
