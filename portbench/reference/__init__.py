"""Plain references, one file per configuration (``<config>.py``). They
import nothing of the port: plain PyTorch, fp32 with TF32 off unless a
caller asks for the lower precision of a control."""
