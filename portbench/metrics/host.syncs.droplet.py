"""``host.syncs`` under the name the droplet cells report it by: there the
end-to-end metric is ``device_ms``."""
from portbench.run import reader_beside

read = reader_beside(__file__, "host.syncs").read
