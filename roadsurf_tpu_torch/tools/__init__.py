"""Measurement tools of the port: nothing of a run imports them."""
