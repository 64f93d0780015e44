"""Entry points of the port: the serving decode function, the profile of
one full-width serving batch or training step, and the traced hot paths
(encode, generate, the eval-mode gradient) of ``cli.profile``."""
