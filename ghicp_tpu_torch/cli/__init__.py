"""Command-line tools: the registration driver and the kernel warm-up."""
