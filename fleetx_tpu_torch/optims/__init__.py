"""Optimizers, gradient clipping and learning-rate schedules."""
