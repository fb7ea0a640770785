"""The plain reference that decides `correct`.

Plain PyTorch at float64, independent of the program: it imports nothing
of the port (nor JAX), takes the configuration's input integrals from the
benchmark's own cache and the program's outputs of each request, and
works out again what the program derived: the integrals at the returned
partial unitary, the active-space Hamiltonian, the state (from the UCCSD
parameters or the CI vector), its energy, its 1-RDM and the gradients
whose vanishing says the solve is done.  `checker(name)` is the check of
a traffic file's "reference" entry (reference/<name>.py).
"""

import importlib


def checker(name: str):
    """The Check class of reference/<name>.py."""
    return importlib.import_module(f"{__name__}.{name}").Check
