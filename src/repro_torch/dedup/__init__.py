"""Stream-quality read-out."""
