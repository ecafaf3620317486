"""Experimental surfaces of the port (``pubsub``)."""
