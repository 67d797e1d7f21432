"""Samplers (UnCLIP prior, DDIM story) and the two-stage pipeline."""
