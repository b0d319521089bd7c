"""One module per head the traffic mixes name (``"head"`` in
benchmark/traffic/<mix>.json): set-up, the measured window over the port's
own loop, and the follow-up that holds the window's output against the
plain reference."""
