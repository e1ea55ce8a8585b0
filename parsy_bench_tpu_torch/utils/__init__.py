"""Host-side utilities of the port: the performance model
(``perfmodel``) and its fit on the card (``calibrate``)."""
