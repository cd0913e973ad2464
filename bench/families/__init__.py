"""Program adapters, one a model family: the port's config from a
configuration file, and what the modes need to know of the port's model."""
