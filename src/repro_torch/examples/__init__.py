"""The port's examples, the reference's ``examples/`` as modules: run each
as ``python -m repro_torch.examples.<name>`` (``quickstart``,
``partitioned_search``, ``serve_msmarco``, ``train_lm``). Each prints the
reference script's lines in its order and wording, takes its flags and one
more, ``--device`` (the card when omitted, raising without one; ``cpu`` on
request), and runs only under ``__main__`` or through ``main(argv)``."""
