"""End-to-end data integrity: per-block CRC32C + verify/repair plumbing.

The integrity layer gives the simulated ZNS stack the missing half of
its fault model: parity can repair silent media faults (bit rot, torn
writes, misdirected writes, latent unreadable sectors) *only if the
host detects them first*.  Detection is a per-block CRC32C computed at
commit time on the packed arenas (``repro_torch.integrity.checksum``), stored
in the drive's per-block checksum store alongside the OOB area and
embedded in the slack bytes of zone footer blocks.

Consumers:

* ``repro_torch.core.zns`` -- checksum store, UNC mask, media-fault
  application, in-place ``repair_block``;
* ``repro_torch.core.array`` -- verify-on-read + reconstruction repair,
  ``scrub_once`` bulk verify;
* ``repro_torch.core.recovery`` -- checksum-validated header/footer winners.
"""
from repro_torch.integrity.checksum import (
    CRC_BYTES,
    crc32c,
    crc32c_many,
    crc32c_pack,
    verify_many,
)

__all__ = [
    "CRC_BYTES",
    "crc32c",
    "crc32c_many",
    "crc32c_pack",
    "verify_many",
]
