"""Model schema, parameters, layers and the forward pass."""
