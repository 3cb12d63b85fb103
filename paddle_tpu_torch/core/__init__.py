"""Device placement, dtype names and length buckets."""
