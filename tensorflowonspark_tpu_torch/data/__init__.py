"""Batches for the train loop: the slab of K stacked batches."""
