"""Entry points: the serving driver (``serve``) and the training driver
(``train``)."""
