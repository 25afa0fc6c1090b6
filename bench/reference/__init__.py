"""Plain PyTorch references the benchmark holds the program to. They
import nothing of the program and take nothing that it made."""
