"""The trainer and serving side of the port: the LM trainer on one device
(``trainer.py``) and the continuous-batching scheduler
(``scheduler.py``)."""
