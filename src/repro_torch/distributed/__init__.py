"""The trainer side of the port: the LM trainer on one device
(``trainer.py``)."""
