"""Core layer: dtype policy, tolerance, options, results."""
