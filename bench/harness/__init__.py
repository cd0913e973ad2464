"""The harness: cells found by name, weights from the seed, spans, yardsticks."""
