"""FasterViT modules, configuration and registry."""
