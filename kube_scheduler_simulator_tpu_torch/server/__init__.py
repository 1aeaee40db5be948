"""The serving layer: a scheduling service over a resource store."""
