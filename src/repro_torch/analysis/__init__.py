"""The dry run's analysis: operation counts and roofline terms."""
