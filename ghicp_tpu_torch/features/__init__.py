"""BSC descriptors and the Hamming feature distance."""
