"""Voxel filter, radius neighbors, neighborhood PCA and keypoints."""
