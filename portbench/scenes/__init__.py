"""Seeded scene writers of the benchmark (see ``mono.py``)."""
