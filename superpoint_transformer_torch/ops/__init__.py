"""Segment ops and the attention kernels (torch), and the host ops of the
NAG path (numpy graph ops, point features, superedges, and the ctypes
binding to native/*.cpp)."""
