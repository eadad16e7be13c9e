"""General drivers of the benchmark: one per kind of traffic, reading
cells, configurations, traffic mixes, metrics and limits by name."""
