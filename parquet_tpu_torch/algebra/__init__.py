"""Order-domain comparison of the port's flat physical types."""
