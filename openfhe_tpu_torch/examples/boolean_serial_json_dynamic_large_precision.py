"""Boolean FHEW, dynamic large-precision, JSON serialization (role of
``binfhe/examples/boolean-serial-json-dynamic-large-precision.cpp``):
identical flow to the binary variant, through the JSON flavor."""

from ._common import device_from_argv
from .boolean_serial_binary_dynamic_large_precision import run


def main(device=None):
    run("json", device)


if __name__ == "__main__":
    main(device_from_argv())
