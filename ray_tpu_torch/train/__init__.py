"""Training: the one-device train step of the port (``spmd``)."""
