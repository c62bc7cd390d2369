"""Text tooling of the port (numpy): the LCP array."""
