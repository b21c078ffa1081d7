"""Core types, transforms, configuration and device selection."""
