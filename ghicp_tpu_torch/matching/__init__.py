"""Cost matrices, the auction (KM) matcher and RANSAC coarse alignment."""
