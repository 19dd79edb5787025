"""The benchmark's own machinery: cells, scene, traffic, records, check."""
