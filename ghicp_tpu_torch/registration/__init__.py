"""Rigid estimators, the GH-ICP engine, the end-to-end pipeline and
station graphs."""
