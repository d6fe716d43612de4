"""The port's counterpart of ``tests/test_many_messages.py``: the same tests, names and
assertions, on ``uigc_tpu_torch``.

Bounds-check the State/Entry/RefobInfo saturation + early-flush paths.

Analogue of the reference's ManyMessagesSpec (reference:
src/test/scala/edu/illinois/osl/uigc/ManyMessagesSpec.scala): A sends
4 * Short.MaxValue messages to B, exercising send-count saturation
(reference: RefobInfo.java:11-13, CRGC.scala:215-216) and recv-count
saturation (State.java:81-88); both actors are then collected.
"""

from uigc_tpu_torch import AbstractBehavior, ActorTestKit, Behaviors, Message, NoRefs, PostStop

NUM_MESSAGES = 4 * 32767
CONFIG = {"uigc.crgc.wakeup-interval": 10}


class Ping(NoRefs):
    pass


class DoneSending(NoRefs):
    def __eq__(self, other):
        return isinstance(other, DoneSending)

    def __hash__(self):
        return hash("DoneSending")


class DoneReceiving(NoRefs):
    def __eq__(self, other):
        return isinstance(other, DoneReceiving)

    def __hash__(self):
        return hash("DoneReceiving")


class Terminated(NoRefs):
    def __eq__(self, other):
        return isinstance(other, Terminated)

    def __hash__(self):
        return hash("Terminated")


class NewAcquaintance(Message):
    def __init__(self, ref):
        self.ref = ref

    @property
    def refs(self):
        return (self.ref,)


class ActorA(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe

    def on_message(self, msg):
        if isinstance(msg, NewAcquaintance):
            ctx = self.context
            for _ in range(NUM_MESSAGES):
                msg.ref.tell(Ping(), ctx)
            self.probe.ref.tell(DoneSending())
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Terminated())
        return None


class ActorB(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        self.probe = probe
        self.count = 0

    def on_message(self, msg):
        if isinstance(msg, Ping):
            self.count += 1
            if self.count == NUM_MESSAGES:
                self.probe.ref.tell(DoneReceiving())
        return self

    def on_signal(self, signal):
        if signal is PostStop:
            self.probe.ref.tell(Terminated())
        return None


class Root(AbstractBehavior):
    def __init__(self, context, probe):
        super().__init__(context)
        ctx = context
        actor_a = ctx.spawn(Behaviors.setup(lambda c: ActorA(c, probe)), "actorA")
        actor_b = ctx.spawn(Behaviors.setup(lambda c: ActorB(c, probe)), "actorB")
        actor_a.tell(NewAcquaintance(ctx.create_ref(actor_b, actor_a)), ctx)
        ctx.release(actor_a, actor_b)

    def on_message(self, msg):
        return self


def test_many_messages_collected():
    kit = ActorTestKit(CONFIG)
    try:
        probe = kit.create_test_probe(timeout_s=60.0)
        kit.spawn(Behaviors.setup_root(lambda ctx: Root(ctx, probe)), "root")
        seen = [probe.expect_message_type(object) for _ in range(4)]
        kinds = sorted(type(m).__name__ for m in seen)
        assert kinds == ["DoneReceiving", "DoneSending", "Terminated", "Terminated"], kinds
    finally:
        kit.shutdown()
