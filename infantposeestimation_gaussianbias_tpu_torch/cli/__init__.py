"""Command-line surfaces of the port: the HTTP pose server (``serve``) and
the image / directory / video inference CLI (``infer``)."""
