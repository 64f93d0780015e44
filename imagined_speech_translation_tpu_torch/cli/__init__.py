"""Entry points of the port: the serving decode function and the profile of
one full-width serving batch."""
