"""Seeded input generators: the genome model and the read models."""
