"""The mesh context, the sharding rules and the GPipe pipeline."""
