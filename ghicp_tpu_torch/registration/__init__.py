"""Rigid estimators, the GH-ICP engine and the end-to-end pipeline."""
