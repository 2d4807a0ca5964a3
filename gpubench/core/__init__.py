"""What every cell shares: the files found by name, the card, the seeded
weights and traffic, the trace reader and the result line."""
