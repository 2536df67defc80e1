"""One module per net, ``<arch>.py``, named by a configuration's
``net.arch`` (``unet`` where it has none): what a driver needs of the net
(``common.manifest.net``)."""
