"""Compacted-graph API: navigation over unitigs (GraphUnitigs analog)."""
