"""Geometry kinds of the reference's scene builder, one module each, named
as a configuration's geometry entry names its ``kind``. A module exports
``triangles(entry) -> (triangles, two_sided)``: the (F, 3, 3) float32
world-space triangles of the entry and whether they are two-sided."""
