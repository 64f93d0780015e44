"""The JAX package's ``examples/`` scripts, as modules of the port run with
``python -m``:

* :mod:`.streaming_demo`: a synthetic or board stream through the wake gate,
  the windowed preprocess and the beam decode to text, with latency stats;
* :mod:`.product_journey_demo`: the whole user story in one process, from
  sign-in to the recordings folder, with the real decode in the middle;
* :mod:`.device_page_demo`: the companion's device page driven over HTTP.

The two that decode run on the card unless given ``--device cpu``.  What
a demo writes goes under ``build/`` unless ``--out`` / ``--workdir`` names
another directory, never into the repository's own files.
"""
