"""Built-in rules — importing this package registers them all."""

from adam_tpu_torch.staticcheck.rules import (  # noqa: F401
    dispatch,
    durability,
    faultpoints,
    hostsync,
    locks,
    residency,
    telemetry_names,
)
