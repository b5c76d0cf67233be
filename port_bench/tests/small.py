"""The cells at sizes a CPU test can hold: the same traffic, runners,
reference and limits as the files', with fewer agents, members and
steps."""

from port_bench import common


def small(cell_name: str) -> tuple[dict, dict]:
    """(cell, config) of ``cell_name`` cut to a CPU test's size."""
    cell = dict(common.workload(cell_name))
    config = dict(common.config(cell["config"]))
    params = dict(cell["params"])
    if cell["kind"] == "episodes":
        config["swarm"] = dict(config["swarm"], n=64)
        params.update(episode_steps=40, segment_steps=10,
                      checks_per_segment=4, stretch_steps=3)
        if params.get("swarm", {}).get("certificate"):
            # The sparse certificate takes over above 128 agents.
            config["swarm"]["n"] = 160
            params.update(segment_steps=4, checks_per_segment=2,
                          stretch_steps=2)
    else:
        config["members"] = 8
        params.update(batch_steps=40, segment_steps=10,
                      check_probability=0.5, stretch_steps=3)
    cell["params"] = params
    return cell, config
