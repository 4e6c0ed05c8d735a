"""Fleet-layer pieces the single-card engine needs (the prefix map)."""
