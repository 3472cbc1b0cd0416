"""Signed distance grids: the host voxelizer and trilinear queries."""
