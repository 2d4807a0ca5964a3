"""Entry points of the port, each running on one device."""
