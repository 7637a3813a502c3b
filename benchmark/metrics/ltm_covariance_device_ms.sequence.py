"""Device ms inside the program's profiler range ``obvi/ltm_covariance`` in
the traced window (the union of the device operations' intervals within
the range): the driver's ``ltm_device_ms``; nothing where the window was
not traced or the program has no such range."""


def read(record):
    return (record.get("ltm_device_ms") or {}).get("ltm_covariance")
