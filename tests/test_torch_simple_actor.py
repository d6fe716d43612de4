"""The port's counterpart of ``tests/test_simple_actor.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Spawn / send / share-ref / release lifecycle.

Analogue of the reference's SimpleActorSpec (reference:
src/test/scala/edu/illinois/osl/uigc/SimpleActorSpec.scala:26-60): actor C
terminates only after *all* owners release their references.
"""

import pytest

from uigc_tpu_torch import AbstractBehavior, ActorTestKit, Behaviors, Message, NoRefs

CONFIG = {"uigc.crgc.wakeup-interval": 10}


class Init(NoRefs):
    pass


class Hello(NoRefs):
    def __eq__(self, other):
        return isinstance(other, Hello)

    def __hash__(self):
        return hash("Hello")


class SendC(NoRefs):
    def __init__(self, msg):
        self.msg = msg


class SendB(NoRefs):
    def __init__(self, msg):
        self.msg = msg


class TellBAboutC(NoRefs):
    pass


class ReleaseC(NoRefs):
    def __eq__(self, other):
        return isinstance(other, ReleaseC)

    def __hash__(self):
        return hash("ReleaseC")


class ReleaseB(NoRefs):
    pass


class Spawned(NoRefs):
    def __init__(self, name):
        self.name = name


class Terminated(NoRefs):
    def __eq__(self, other):
        return isinstance(other, Terminated)

    def __hash__(self):
        return hash("Terminated")


class GetRef(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class ActorA(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.actor_b = None
        self.actor_c = None

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, Init):
            self.actor_b = ctx.spawn(actor_b_factory(self.probe), "actorB")
            self.actor_c = ctx.spawn(actor_c_factory(self.probe), "actorC")
        elif isinstance(msg, SendC):
            self.actor_c.tell(msg.msg, ctx)
        elif isinstance(msg, SendB):
            self.actor_b.tell(msg.msg, ctx)
        elif isinstance(msg, TellBAboutC):
            ref = ctx.create_ref(self.actor_c, self.actor_b)
            self.actor_b.tell(GetRef(ref), ctx)
        elif isinstance(msg, ReleaseC):
            ctx.release(self.actor_c)
        elif isinstance(msg, ReleaseB):
            ctx.release(self.actor_b)
        return self


class ActorB(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.actor_c = None
        probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        ctx = self.context
        if isinstance(msg, GetRef):
            self.actor_c = msg.ref
        elif isinstance(msg, SendC):
            self.actor_c.tell(msg.msg, ctx)
        elif isinstance(msg, ReleaseC):
            ctx.release(self.actor_c)
        return self

    def on_signal(self, signal):
        from uigc_tpu_torch import PostStop

        if signal is PostStop:
            self.probe.ref.tell(Terminated())
        return None


class ActorC(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        probe.ref.tell(Spawned(context.name))

    def on_message(self, msg):
        if isinstance(msg, Hello):
            self.probe.ref.tell(Hello())
        return self

    def on_signal(self, signal):
        from uigc_tpu_torch import PostStop

        if signal is PostStop:
            self.probe.ref.tell(Terminated())
        return None


def actor_b_factory(probe):
    return Behaviors.setup(lambda ctx: ActorB(ctx, probe))


def actor_c_factory(probe):
    return Behaviors.setup(lambda ctx: ActorC(ctx, probe))


@pytest.mark.parametrize(
    "style", ["on-block", "on-idle", "wave"]
)
def test_simple_actor_lifecycle(style):
    config = dict(CONFIG)
    config["uigc.crgc.collection-style"] = style
    if style == "wave":
        config["uigc.crgc.wave-frequency"] = 10
    kit = ActorTestKit(config)
    try:
        probe = kit.create_test_probe()
        actor_a = kit.spawn(
            Behaviors.setup_root(lambda ctx: ActorA(ctx, probe)), "actorA"
        )

        # spawn actors
        actor_a.tell(Init())
        probe.expect_message_type(Spawned)
        probe.expect_message_type(Spawned)

        # send messages
        actor_a.tell(SendC(Hello()))
        probe.expect_message(Hello())

        # share references
        actor_a.tell(TellBAboutC())
        actor_a.tell(SendB(SendC(Hello())))
        probe.expect_message(Hello())

        # no termination while some owners still exist
        actor_a.tell(ReleaseC())
        probe.expect_no_message(0.3)

        # still usable through the other owner
        actor_a.tell(SendB(SendC(Hello())))
        probe.expect_message(Hello())

        # terminate after all references released
        actor_a.tell(SendB(ReleaseC()))
        probe.expect_message(Terminated())

        # terminate after the only reference is released
        actor_a.tell(ReleaseB())
        probe.expect_message(Terminated())
    finally:
        kit.shutdown()
