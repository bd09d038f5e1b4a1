"""Model assembly of the port: config, blocks, model, weight import."""
