"""The plain reference of the benchmark's check: fp32 PyTorch with TF32
off, importing nothing of the program.  It follows the port's tracking
step by step from captured state (``steps.py``) with a DroidNet of its
own loaded from the checkpoint file (``net.py``)."""
