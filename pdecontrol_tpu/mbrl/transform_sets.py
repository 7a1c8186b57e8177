"""The controller's transform wiring (reference ``setup_transforms``,
mbrl.py:146-188) as one pytree.

Spaces:
  * raw/physical — env fields and env-bounds actions (what the replay
    stores; reference workers read these back out of Store wrappers).
  * world — surrogate space: obs = world_sensor(oscaling(raw)); actions =
    world_sensor(pdescaling(forcing(env_action))) (the forcing FIELD).
  * agent — SAC space: obs = agent_sensor(world_obs); actions in [-1, 1].

``oscaling`` is the only frozen=False transform during collection: its
running min/max update happens inside the jitted collect step, with the
state carried in this pytree (reference updates it imperatively inside
``TransformObsWrapper``, vec_wrappers.py:157-160, mbrl.py:260).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pdecontrol_tpu.envs.transforms import (
    Chain,
    GaussianForcing,
    Normalize,
    SampleTransform,
    Scale,
    Sensor,
    Transform,
)
from pdecontrol_tpu.utils.pytree import PyTreeNode

Array = jax.Array


class ControllerTransforms(PyTreeNode):
    oscaling: Scale
    ascaling: Transform  # inverse view: apply = [-1,1] -> env bounds
    forcing: GaussianForcing
    pdescaling: Scale
    undscaling: Normalize
    agent_sensor: Sensor
    world_sensor: Sensor

    @classmethod
    def create(cls, env, agent_stride: int = 1, world_stride: int = 1,
               dtype=jnp.float32) -> "ControllerTransforms":
        obs_shape = (1,) + tuple(env.obs_shape)  # [B, C, H]
        act_shape = (1,) + tuple(env.action_shape)

        oscaling = Scale.create(obs_shape, aggregate=True, batched=True,
                                frozen=False, dtype=dtype)

        low = np.full(act_shape, env.action_low, np.float32)
        high = np.full(act_shape, env.action_high, np.float32)
        ascaling = Scale.create(
            act_shape, bounds=(low, high), aggregate=True, batched=True,
            frozen=True, dtype=dtype,
        ).inv

        forcing = env.forcing

        flow = np.asarray(forcing.apply(jnp.asarray(low, dtype)))
        fhigh = np.asarray(forcing.apply(jnp.asarray(high, dtype)))
        # Jet superposition can exceed single-jet extremes in either sign;
        # pool elementwise min/max like the reference's bounds intent.
        pdescaling = Scale.create(
            flow.shape[1:],
            bounds=(np.minimum(flow, fhigh)[0], np.maximum(flow, fhigh)[0]),
            aggregate=True, frozen=True, dtype=dtype,
        )

        undscaling = Normalize.create(obs_shape, aggregate=True, batched=True,
                                      dtype=dtype)

        return cls(
            oscaling=oscaling,
            ascaling=ascaling,
            forcing=forcing,
            pdescaling=pdescaling,
            undscaling=undscaling,
            agent_sensor=Sensor(stride=agent_stride),
            world_sensor=Sensor(stride=world_stride),
        )

    # ------------------------------------------------------------ obs paths
    def raw_to_world_obs(self, raw: Array) -> Array:
        return self.world_sensor.apply(self.oscaling.apply(raw))

    def world_to_agent_obs(self, world_obs: Array) -> Array:
        return self.agent_sensor.apply(world_obs)

    def raw_to_agent_obs(self, raw: Array) -> Array:
        return self.world_to_agent_obs(self.raw_to_world_obs(raw))

    def world_to_raw_obs(self, world_obs: Array) -> Array:
        return self.oscaling.inverse(self.world_sensor.inverse(world_obs))

    # --------------------------------------------------------- action paths
    def agent_to_env_action(self, action: Array) -> Array:
        """[-1,1] -> env bounds (TransformActionWrapper(ascaling),
        mbrl.py:269)."""
        return self.ascaling.apply(action)

    def env_action_to_agent(self, action: Array) -> Array:
        return self.ascaling.inverse(action)

    def env_action_to_world(self, action: Array) -> Array:
        """env-bounds action -> scaled forcing field (the world env's action
        space; mbrl.py:321-330 stack: forcing -> pdescaling -> sensor)."""
        field = self.forcing.apply(action)
        return self.world_sensor.apply(self.pdescaling.apply(field))

    def world_action_to_phys_field(self, waction: Array) -> Array:
        return self.pdescaling.inverse(self.world_sensor.inverse(waction))

    # ------------------------------------------------------- sample bridges
    @property
    def replay_to_agent(self) -> SampleTransform:
        return SampleTransform(
            otransf=Chain(transforms=(self.oscaling, self.agent_sensor)),
            atransf=self.ascaling.inv,
        )

    @property
    def replay_to_world(self) -> SampleTransform:
        return SampleTransform(
            otransf=Chain(transforms=(self.oscaling, self.world_sensor)),
            atransf=Chain(
                transforms=(self.forcing, self.pdescaling, self.world_sensor)
            ),
        )

    @property
    def world_replay_to_agent(self) -> SampleTransform:
        # Imagined obs are stored already in world space; actions in agent
        # space (mbrl.py:188 + the world stack's store positions).  The agent
        # sensor still applies on top of world space (identity at stride 1;
        # the reference omits it and would shape-crash for stride > 1).
        return SampleTransform(otransf=self.agent_sensor,
                               atransf=self.ascaling.inv)
